"""Many cameras on one card: the fleet entry points."""
