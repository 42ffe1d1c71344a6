"""The visited store's tiers below the device hash slab (store/tiered.py)."""
