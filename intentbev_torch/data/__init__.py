"""Host half of the input pipeline (batch stacking for the transports)."""
