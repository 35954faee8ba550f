"""Host-side helpers of the recognition path."""
