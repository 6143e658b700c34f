"""Plain references that decide ``correct``: numpy and torch only."""
