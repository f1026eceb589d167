"""Host-side lattice container and receipt signing."""
