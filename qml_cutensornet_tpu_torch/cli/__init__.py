"""Command-line entry points with the reference's argv contract."""
