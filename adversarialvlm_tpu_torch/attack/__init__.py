"""The single-victim pixel attack: config, step, victim setup, driver loop."""
