"""The eval step; the train step is the next slice."""
