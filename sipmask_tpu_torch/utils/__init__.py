"""Weight conversion, initialisation and synthetic batches of the port."""
