"""Host-side data for generation: manifests, raw decode, datasets, batching."""
