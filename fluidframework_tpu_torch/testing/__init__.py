"""Test and smoke helpers of the port: seeded multi-client sessions.

JAX counterpart: ``tests/mergetree_fixtures.py``.
"""
