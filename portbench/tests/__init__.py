"""The harness's CPU tests; the tests that need a card skip without one."""
