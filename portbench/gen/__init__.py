"""Seeded inputs: boards, symmetry transforms and arrival schedules."""
