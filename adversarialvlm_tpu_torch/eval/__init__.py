"""Evaluation harnesses of the port."""
