"""MAGICC atmospheric chemistry components."""
