"""The federation plane: messages, the comm manager and its transports."""
