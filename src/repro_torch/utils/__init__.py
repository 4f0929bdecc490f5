"""Tree helpers and weight carrying between the two packages."""
