"""Process utilities the port's coordination layer needs: failpoints,
tracing spans, structured logging, sensors and named locks (own copies of
the JAX package's `utils/` modules, as far as the port reads them)."""
