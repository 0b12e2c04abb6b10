"""Decoder models of the port."""
