"""Plain references of the configurations' models: one file a model."""
