"""Model settings: the paper's datasets, the LM archs the port serves
(``base``'s ``ArchSpec`` per arch, looked up by id through
``registry``), and their ``reduced`` forms."""
