"""The batch data model and host-side batch layout helpers."""
