"""Host input pipeline: AV2-format logs (``argoverse``), the synthetic log
writer (``synthetic``), batching and prefetch (``pipeline``)."""
