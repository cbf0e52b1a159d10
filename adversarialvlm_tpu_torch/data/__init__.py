"""Prompt and answer corpora."""
