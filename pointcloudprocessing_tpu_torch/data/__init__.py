"""Host-side data handling of the port: AftrBurner frames and pose logs,
the TFRecord codec, ``PointCloudSet`` and the batch loaders."""
