"""Ranking model layers and scorers (eval path)."""
