"""Host-side image preprocessing of the port."""
