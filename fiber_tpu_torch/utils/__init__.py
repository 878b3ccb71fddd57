"""Operation counts and device peaks."""
