"""List algebra, gain and discount functions, and device selection."""
