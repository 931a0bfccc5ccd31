"""Persistence: checkpoint/resume (`checkpoint`), animation export
(`animation`) and the native framepack writer (`native`). Import the
submodules themselves; this package imports nothing at load."""
