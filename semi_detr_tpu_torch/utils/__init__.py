"""Config loading, weight carriers and logging."""
