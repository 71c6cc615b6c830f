"""Host-side statistics the volume server reports."""
