"""Tokenization, logging, PNG files and device selection."""
