"""Effects of the port: gain, eq5, chorus, reverb."""
