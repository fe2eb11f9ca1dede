"""Device setup, data pipeline and run naming."""
