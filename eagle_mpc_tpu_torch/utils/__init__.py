"""Host utilities: leveled logging and mission tools."""
