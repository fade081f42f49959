"""Model configurations and cell shapes of the port's model slices."""
