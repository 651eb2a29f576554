"""Host-side data: the Kinetics clip index and dataset, frame-folder
datasets, the host augmentations, the threaded loader, the prefetcher that
copies batches to the card, the DAVIS-style VOS dataset and the JHMDB
pose dataset."""
