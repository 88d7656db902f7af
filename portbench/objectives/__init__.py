"""How the port trains on each kind of traffic: one file an objective."""
