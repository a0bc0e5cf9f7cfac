"""The paper's own workload settings (``paper_suite``) and the reference
package's paper-size results the port is held to (``paper_expected.json``)."""
