"""Launch surfaces of the port: the serving engine and its CLI."""
