"""Multi-device axes of the port: ``mesh`` (data, space and model positions)
and ``pp`` (pipeline stages), one process driving explicit device positions,
each with a CUDA stream of its own."""
