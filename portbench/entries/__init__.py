"""Systems under test, one module a configuration's ``entry``: each has
``build(config, device, wrap_step)``, whose result is called once a
request."""
