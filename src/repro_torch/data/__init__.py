"""Data of the port: synthetic datasets and the zarr-lite store."""
