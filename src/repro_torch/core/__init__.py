"""CycleSL core: split tasks, feature store, cyclical updates."""
