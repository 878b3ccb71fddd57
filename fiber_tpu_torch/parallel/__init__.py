"""The device mesh of the port."""
