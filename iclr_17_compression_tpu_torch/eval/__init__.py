"""Kodak-style evaluation."""
