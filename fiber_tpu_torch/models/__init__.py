"""Models, environments and policies of the port."""
