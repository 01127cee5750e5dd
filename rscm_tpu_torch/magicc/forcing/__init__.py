"""MAGICC forcing components."""
