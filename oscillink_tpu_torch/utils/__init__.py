"""Host utilities: device resolution."""
