"""Differentiable image preprocessing and attack input builders."""
