"""Offline tools of the recipes (source separation of dataset folders)."""
