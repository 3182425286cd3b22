"""Framework-free helpers of the port: shapes, datasets, stats."""
