"""Core planar pipeline and the batching helpers of the public API."""
