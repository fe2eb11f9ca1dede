"""Host backends of the port: the native C++ CPU engine's tile scheduler
(``cpu_native``)."""
