"""Parameter selection and the weight bridge from the JAX package."""
