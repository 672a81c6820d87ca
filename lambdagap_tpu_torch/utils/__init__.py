"""Host utilities of the port: logging, device resolution, kernel builds."""
