"""The benchmark suites; importing a module registers its suite
(:func:`repro_torch.bench.driver.import_suite_modules` imports them all)."""
