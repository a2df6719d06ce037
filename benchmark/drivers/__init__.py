"""Drivers: build and step one kind of system as its entry point does."""
