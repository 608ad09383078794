"""Host-side view data and synthetic cameras (port of ``splatpu/data``)."""
