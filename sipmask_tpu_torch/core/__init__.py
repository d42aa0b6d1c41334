"""Box and point geometry, targets and losses of the port."""
