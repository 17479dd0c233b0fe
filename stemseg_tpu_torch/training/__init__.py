"""The trainer: losses composed into a train step with gradient
accumulation, optimizer and LR schedule, checkpoints, loader and CLI."""
