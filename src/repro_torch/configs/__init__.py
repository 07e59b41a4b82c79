"""Model configurations: ``ModelConfig`` and the ten published presets."""
