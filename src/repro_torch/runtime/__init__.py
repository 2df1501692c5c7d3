"""Runtime of the port: device selection, the chunk streamer, store integrity."""
