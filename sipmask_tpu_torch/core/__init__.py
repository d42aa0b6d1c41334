"""Box and point geometry of the port."""
