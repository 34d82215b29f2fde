"""The corpus kind ``vendored``: the choosealicense.com templates that
licensee vendors (`vendor/choosealicense.com/_licenses`), hidden ones
included and pseudo-licenses left out, as the port's ``--corpus
vendored`` compiles them."""


def port_source(config: dict) -> str:
    """The port's ``--corpus`` argument."""
    return "vendored"


def reference_templates(config: dict) -> list:
    """The templates through the frozen license loader, in the port's
    order."""
    from gpubench.ref.license import License

    return License.all(hidden=True, pseudo=False)
