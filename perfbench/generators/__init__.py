"""The general traffic generators, one a kind of timed entry."""
