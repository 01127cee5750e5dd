"""MAGICC carbon-cycle components."""
