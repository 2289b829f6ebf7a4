"""Fictitious-domain problem setup (host numpy fp64)."""
