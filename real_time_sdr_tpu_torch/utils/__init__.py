"""Host-side utilities: state conversion, PCM formatting, synthesis."""
