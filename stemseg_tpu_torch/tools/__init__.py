"""Command-line tools of the port that chain its entry points."""
