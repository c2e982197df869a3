"""Config, logging, device selection and device timing."""
