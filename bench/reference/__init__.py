"""Plain reference of graph extraction and its control (no program code)."""
