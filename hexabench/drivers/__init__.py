"""One driver a kind of entry: train steps, or a serving engine."""
