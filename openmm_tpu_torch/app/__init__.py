"""The application layer of the port: the Amber GB recipes (gbforces)."""
