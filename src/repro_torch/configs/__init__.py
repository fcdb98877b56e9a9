"""Architecture and shape descriptors (`repro/configs`)."""
