"""Tree model, model text and the loaded-model booster."""
