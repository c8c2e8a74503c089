"""Divisibility-aware parameter placement (``rules``) and logical axis
names (``context``), over the port's mesh of axis sizes."""
