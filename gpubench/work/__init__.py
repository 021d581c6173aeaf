"""The least work of one batch of a kernel's job, counted from the batch
itself and not from any kernel's launch shape, so that the count stays
the same whichever kernel does the job (one module per kernel)."""
