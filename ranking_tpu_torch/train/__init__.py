"""The train state and the train and eval steps."""
