"""BEV transport helpers of the port."""
