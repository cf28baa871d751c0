"""Multi-stream operation: N camera streams through one batched step per
tick (the batched tracking core, the batched frontend step, StreamPool)."""
