"""Host-side utilities: stage timing and trace ranges."""
