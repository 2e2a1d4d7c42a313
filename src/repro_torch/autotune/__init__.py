"""Auto-tuning of the framework itself: the distribution hillclimb."""
