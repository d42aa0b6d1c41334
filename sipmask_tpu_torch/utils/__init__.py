"""Weight conversion and initialisation of the port."""
