"""Device-side test doubles of the port."""
