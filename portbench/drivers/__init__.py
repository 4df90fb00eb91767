"""Timed loops, one file a direction, named by a traffic mix's ``driver``."""
