"""Tools of the port that stay out of the pipeline (the int16 probe)."""
