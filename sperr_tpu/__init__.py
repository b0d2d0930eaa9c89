"""sperr_tpu: an accelerator-native SPERR-capability lossy compressor for
scientific data.

Dense stages (CDF 9/7 wavelets, conditioning, midtread quantization, outlier
detection) and the SPECK bitplane entropy stage run on the GPU via JAX/XLA,
batched over volume chunks and sharded across a device mesh; the host runs
the native C++ SPECK engine (plus a NumPy reference engine).  Streams are
byte-compatible with NCAR/SPERR.
"""

__version__ = "0.1.0"

# Container format major version, matching the reference (SperrConfig: 0.8.5).
SPERR_VERSION_MAJOR = 0
