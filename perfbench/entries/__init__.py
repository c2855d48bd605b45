"""What runs a window, one module an entry kind, named by a traffic
file's ``entry`` key."""
