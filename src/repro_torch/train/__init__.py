"""Serving (and, in a later slice, training) loops of the port."""
