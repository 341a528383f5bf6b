"""Serving and standalone evaluation."""
