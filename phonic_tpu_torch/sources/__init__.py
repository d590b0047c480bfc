"""Sources of the port: file playback."""
