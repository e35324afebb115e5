"""Config loading, weight carriers, logging and the label text."""
