"""The benchmark's harness: the cells' specs (`spec`), the traffic generator
(`traffic`), the adapter to the program under test (`program`), the
yardstick (`cost`, `stats`, `trace`, `check`), the precision controls
(`controls`) and one run (`core`)."""
