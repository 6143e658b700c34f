"""Compatibility facades for external packages the reference ecosystem
assumes (importable by prepending this directory to sys.path)."""
